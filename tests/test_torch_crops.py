"""
The port's random crops against the JAX package's, on the CPU.

Threefry and Philox streams cannot match, so crops are held against
JAX's ``dynamic_crop`` at injected starts (bit-equal), the foreground
indices bit-equal (the same numpy seed), the foreground-centre path at an
injected centre, and the mapping of foreground voxels through a rotation
plus flip within one voxel of where the warp puts them. The draws are
checked statistically: starts uniform over [0, max], the positive share
near ``pos_ratio``, every positive crop holding its centre.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.transforms import host as jhost
from adell_mri_tpu.transforms import spatial as jS
from adell_mri_torch.transforms import host as thost
from adell_mri_torch.transforms import pipeline as tpipe
from adell_mri_torch.transforms import spatial as tS


def _vol(seed, shape=(16, 16, 16, 2)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("max_fg,p", [(4096, 0.1), (64, 0.3), (16, 0.0)])
def test_precompute_fg_indices_bit_equal(max_fg, p):
    rng = np.random.default_rng(int(100 * p) + max_fg)
    label = (rng.uniform(size=(16, 16, 16)) < p).astype(np.float32)
    got, n = thost.precompute_fg_indices(label, max_fg)
    want, wn = jhost.precompute_fg_indices(label, max_fg)
    assert n == wn
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start", [(0, 0, 0), (3, 5, 7), (8, 8, 8),
                                   (20, -3, 9)])
def test_random_crop_at_start_matches_dynamic_crop(start):
    vol = _vol(0)
    size = (8, 8, 8)
    got = tS.random_crop(None, torch.from_numpy(vol), size,
                         start=torch.tensor(start))
    want = jS.dynamic_crop(jnp.asarray(vol), jnp.asarray(start), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("start", [(1, 2, 3), (8, 0, 4)])
def test_pos_neg_crop_at_start_matches_dynamic_crop(start):
    vol = _vol(1)
    label = (_vol(2, (16, 16, 16)) > 0.8).astype(np.float32)
    size = (8, 8, 12)
    fg, n = thost.precompute_fg_indices(label)
    img, lab, st = tS.pos_neg_crop(
        None, torch.from_numpy(vol), torch.from_numpy(label), size,
        torch.from_numpy(fg), n, start=torch.tensor(start))
    np.testing.assert_array_equal(
        img.numpy(), np.asarray(jS.dynamic_crop(jnp.asarray(vol),
                                                jnp.asarray(start), size)))
    np.testing.assert_array_equal(
        lab.numpy(), np.asarray(jS.dynamic_crop(
            jnp.asarray(label[..., None]), jnp.asarray(start), size))[..., 0])
    assert tuple(st.tolist()) == start


@pytest.mark.parametrize("centre", [(0, 0, 0), (7, 9, 3), (15, 15, 15),
                                    (2, 14, 8)])
def test_fg_centre_start_matches_jax(centre):
    """With pos_ratio 1 and one valid row, both sides centre on it: the
    start and both crops are equal."""
    import jax

    vol = _vol(3)
    label = np.zeros((16, 16, 16), np.float32)
    label[centre] = 1.0
    size = (8, 6, 4)
    fg = np.zeros((16, 3), np.int32)
    fg[0] = centre
    img, lab, st = tS.pos_neg_crop(
        torch.Generator().manual_seed(0), torch.from_numpy(vol),
        torch.from_numpy(label), size, torch.from_numpy(fg), 1,
        pos_ratio=1.0)
    jimg, jlab, jst = jS.pos_neg_crop(
        jax.random.PRNGKey(0), jnp.asarray(vol), jnp.asarray(label), size,
        jnp.asarray(fg), jnp.asarray(1), pos_ratio=1.0)
    assert st.tolist() == np.asarray(jst).tolist()
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab)[..., 0])
    assert float(lab.sum()) == 1.0


def _rotation_flip(shape, angles, flips):
    """Output voxel -> input voxel: a rotation about the centre, then a
    reflection of each axis in ``flips`` (the order ``_augment_one``
    composes them)."""
    rot = tS.rotation_matrix(3, torch.tensor(angles))
    centre = tS.center_matrix(shape, +1.0)
    back = tS.center_matrix(shape, -1.0)
    gates = torch.tensor([True, False, True]) if flips else torch.zeros(
        3, dtype=torch.bool)
    return centre @ rot @ back @ tS._flip_matrix(gates, shape, (0, 1, 2))


@pytest.mark.parametrize("angles,flips", [((0.35, -0.2, 0.3), True),
                                          ((-0.3, 0.25, -0.1), True),
                                          ((0.35, 0.0, 0.0), False)])
def test_fg_centre_follows_rotation_and_flip(angles, flips):
    """A foreground voxel mapped through ``inv(geom)`` lands within one
    voxel of the centroid of where the warp (port's and JAX's, nearest)
    puts a small ball around it."""
    shape = (24, 24, 16)
    geom = _rotation_flip(shape, angles, flips)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                                indexing="ij"), -1)
    for centre in ((5, 6, 4), (18, 7, 11), (12, 19, 3)):
        ball = ((grid - np.asarray(centre)) ** 2).sum(-1) <= 1.5 ** 2
        label = ball.astype(np.float32)[..., None]
        warped = tS.warp_affine(torch.from_numpy(label), geom,
                                method="nearest")[..., 0].numpy()
        jwarped = np.asarray(jS.warp_affine(
            jnp.asarray(label), jnp.asarray(geom.numpy()),
            method="nearest"))[..., 0]
        np.testing.assert_array_equal(warped, jwarped)
        assert warped.sum() > 0
        landed = np.argwhere(warped > 0).mean(0)
        mapped = tpipe.fg_through_geometry(
            torch.tensor([centre], dtype=torch.int32), geom, shape)[0]
        assert np.abs(mapped.numpy() - landed).max() <= 1.0, (
            centre, mapped, landed)


def test_uniform_starts_cover_the_range():
    vol = torch.zeros((32, 32, 16, 1))
    label = torch.zeros((32, 32, 16))
    size = (8, 8, 4)
    maxs = np.array([24, 24, 12])
    g = torch.Generator().manual_seed(0)
    fg = torch.zeros((4, 3), dtype=torch.int32)
    n = 4000
    starts = np.stack([
        tS.pos_neg_crop(g, vol, label, size, fg, 0, pos_ratio=0.5)[2]
        .numpy() for _ in range(n)])
    assert starts.min(0).tolist() == [0, 0, 0]
    assert starts.max(0).tolist() == maxs.tolist()
    for d in range(3):
        counts = np.bincount(starts[:, d], minlength=maxs[d] + 1)
        expect = n / (maxs[d] + 1)
        # every value within 5 binomial standard deviations
        assert np.abs(counts - expect).max() < 5 * np.sqrt(expect), counts


@pytest.mark.parametrize("pos_ratio", [0.5, 0.25])
def test_positive_share_and_centres(pos_ratio):
    shape, size = (32, 32, 16), (8, 8, 4)
    rng = np.random.default_rng(1)
    fg_np = np.stack([rng.integers(0, s, 50) for s in shape], -1)
    label = np.zeros(shape, np.float32)
    label[tuple(fg_np.T)] = 1.0
    fg = np.zeros((64, 3), np.int32)
    fg[:50] = fg_np
    vol = torch.from_numpy(label[..., None])
    lab = torch.from_numpy(label)
    fg_t = torch.from_numpy(fg)
    centred = {
        tuple(tS.fg_centred_start(torch.from_numpy(c), shape, size).tolist()):
        c for c in fg_np
    }
    g = torch.Generator().manual_seed(2)
    n, pos = 2000, 0
    for _ in range(n):
        img, crop, st = tS.pos_neg_crop(g, vol, lab, size, fg_t, 50,
                                        pos_ratio=pos_ratio)
        assert img.shape == size + (1,) and crop.shape == size
        key = tuple(st.tolist())
        if key in centred:
            pos += 1
            # a positive crop holds its centre
            local = centred[key] - st.numpy()
            assert crop[tuple(local)] == 1.0
    # uniform starts hit one of the 50 centred ones with p < 50 / 8125
    share = pos / n
    assert abs(share - pos_ratio) < 0.05, share


def test_augment_crops_keep_label_on_foreground():
    """pos_ratio 1 through a rotation and flips (every op fires): each
    crop centres on a foreground voxel carried through the warp, so every
    label crop holds foreground, and the image (the label itself) stays
    aligned with it."""
    shape, size = (32, 32, 16), (8, 8, 4)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                                indexing="ij"), -1)
    labels, fgs, ns = [], [], []
    for c in ((4, 5, 3), (26, 25, 12), (6, 27, 10), (27, 4, 4)):
        lab = (((grid - np.asarray(c)) ** 2).sum(-1) <= 1.5 ** 2)
        lab = lab.astype(np.float32)
        fg, n = thost.precompute_fg_indices(lab, 64)
        labels.append(lab)
        fgs.append(fg)
        ns.append(n)
    labels = np.stack(labels)
    for flags in (["flip"], ["affine", "flip"]):
        policy = tpipe.AugmentPolicy.from_flags(
            flags, prob=1.0, flip_prob=0.5, scale_range=0.0,
            flip_axes=(0, 1, 2))
        tr = tpipe.SegmentationTransforms(augmentations=policy,
                                          crop_size=size, pos_ratio=1.0,
                                          max_fg=64)
        g = torch.Generator().manual_seed(3)
        for _ in range(5):
            batch = {
                "image": torch.from_numpy(labels[..., None]),
                "label": torch.from_numpy(labels),
                "fg_indices": torch.from_numpy(np.stack(fgs)),
                "n_fg": torch.tensor(ns, dtype=torch.int32),
            }
            out = tr.augment(g, batch)
            assert set(out) == {"image", "label"}
            assert tuple(out["image"].shape) == (4,) + size + (1,)
            assert tuple(out["label"].shape) == (4,) + size
            assert (out["label"].sum((1, 2, 3)) > 0).all(), flags
            if flags == ["flip"]:
                torch.testing.assert_close(out["image"][..., 0],
                                           out["label"], rtol=0, atol=0)

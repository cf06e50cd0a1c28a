"""
Device-side spatial augmentation: one affine warp as a gather.

Counterpart of the gather path of ``adell_mri_tpu/transforms/spatial.py``
(``sample_volume``, ``affine_coords``, ``warp_affine`` with its elastic
``displacement``, ``random_elastic_displacement``, the matrix builders,
``random_flip``, ``random_flip_with_matrix``, ``compose_flips``) and its
crops (``dynamic_crop``, ``random_crop``, ``pos_neg_crop``).
The JAX package's separable shear warp serves only its TPU; off the TPU it
takes this gather path, and so does the port. All geometry composes into
one homogeneous matrix mapping output voxel -> input voxel, applied by one
trilinear (or nearest) gather.

Volumes are channels-last ``[*S, C]``; matrices are (ndim+1)^2 in voxel
units. Random draws come from an explicit ``torch.Generator`` on the
volume's device. Small constants reach the card by an asynchronous copy
(``host_vector``), so the augmentation makes the host wait for the card
nowhere.
"""

from typing import Optional, Sequence

import torch

from adell_mri_torch.models.layers.multi_resolution import resize_volume


def host_vector(values, device=None):
    """A f32 vector of host numbers on ``device``, copied without making
    the host wait for the card (a pageable copy is staged before the call
    returns)."""
    t = torch.tensor(values, dtype=torch.float32)
    if device is None or torch.device(device).type == "cpu":
        return t
    return t.to(device, non_blocking=True)


def sample_volume(vol, coords, method: str = "linear", cval: float = 0.0):
    """Samples ``vol`` [*S, C] at fractional voxel ``coords`` [ndim, *out_S],
    trilinear (``"linear"``) or nearest (half to even, as ``jnp.round``).
    Points outside [0, s-1] on any axis take ``cval``."""
    ndim = coords.shape[0]
    spatial = vol.shape[:ndim]
    in_bounds = torch.ones(coords.shape[1:], dtype=torch.bool,
                           device=coords.device)
    for d in range(ndim):
        in_bounds &= (coords[d] >= 0) & (coords[d] <= spatial[d] - 1)
    if method == "nearest":
        idx = [
            torch.round(coords[d]).long().clamp(0, spatial[d] - 1)
            for d in range(ndim)
        ]
        out = vol[tuple(idx)]
    else:
        lo_f = [torch.floor(coords[d]) for d in range(ndim)]
        frac = [coords[d] - lo_f[d] for d in range(ndim)]
        lo = [lo_f[d].long().clamp(0, spatial[d] - 1) for d in range(ndim)]
        hi = [(lo[d] + 1).clamp(0, spatial[d] - 1) for d in range(ndim)]
        out = 0.0
        for corner in range(2**ndim):
            idx, w = [], 1.0
            for d in range(ndim):
                if corner >> d & 1:
                    idx.append(hi[d])
                    w = w * frac[d]
                else:
                    idx.append(lo[d])
                    w = w * (1.0 - frac[d])
            out = out + vol[tuple(idx)] * w[..., None]
    return torch.where(
        in_bounds[..., None], out,
        torch.full((), cval, dtype=vol.dtype, device=vol.device),
    )


def affine_coords(matrix, out_shape: Sequence[int]):
    """Homogeneous matrix -> input coordinates [ndim, *out_shape] of every
    output voxel, each ``((m0 i + m1 j) + m2 k) + m3`` in that order (no
    matrix product, whose order each library picks: the card and the CPU
    give the same bits)."""
    ndim = len(out_shape)
    m = matrix.float()
    axes = [
        torch.arange(s, dtype=torch.float32, device=m.device).reshape(
            [-1 if a == d else 1 for a in range(ndim)])
        for d, s in enumerate(out_shape)
    ]
    rows = []
    for r in range(ndim):
        c = m[r, 0] * axes[0]
        for d in range(1, ndim):
            c = c + m[r, d] * axes[d]
        rows.append((c + m[r, ndim]).expand(tuple(out_shape)))
    return torch.stack(rows)


def warp_affine(
    vol,
    matrix,
    out_shape: Optional[Sequence[int]] = None,
    method: str = "linear",
    cval: float = 0.0,
    displacement=None,
):
    """Output voxel o samples the input at ``matrix @ o +
    displacement[:, o]``; ``displacement`` [ndim, *out_shape] is in
    voxels (f32)."""
    out_shape = tuple(out_shape or vol.shape[:-1])
    coords = affine_coords(matrix, out_shape)
    if displacement is not None:
        coords = coords + displacement.float()
    return sample_volume(vol, coords, method=method, cval=cval)


def draw_elastic_grid(generator, ndim: int, grid_size: int = 4,
                      magnitude=2.0, device=None):
    """The coarse displacement grid [ndim, g, ..., g] of
    ``random_elastic_displacement``: normal draws times ``magnitude``."""
    return torch.randn((ndim,) + (grid_size,) * ndim, generator=generator,
                       device=device) * magnitude


def elastic_displacement(coarse, out_shape: Sequence[int]):
    """The coarse grid [ndim, g, ..., g] cubic-resized to the displacement
    field [ndim, *out_shape] (f32)."""
    return resize_volume(coarse.float(),
                         (coarse.shape[0],) + tuple(out_shape), "cubic")


def random_elastic_displacement(generator, out_shape: Sequence[int],
                                grid_size: int = 4, magnitude=2.0,
                                device=None):
    """A smooth random displacement field [ndim, *out_shape] in voxels
    (Rand3DElasticd's analogue): a coarse normal grid, cubic-resized."""
    return elastic_displacement(
        draw_elastic_grid(generator, len(out_shape), grid_size, magnitude,
                          device),
        out_shape,
    )


# -- matrix builders ----------------------------------------------------------


def _homogeneous(ndim: int, linear, translation):
    m = torch.eye(ndim + 1, dtype=torch.float32, device=linear.device)
    m[:ndim, :ndim] = linear
    m[:ndim, ndim] = translation
    return m


def center_matrix(shape: Sequence[int], sign: float = 1.0, device=None):
    ndim = len(shape)
    c = host_vector([sign * (s - 1) / 2.0 for s in shape], device)
    return _homogeneous(ndim, torch.eye(ndim, device=device), c)


def rotation_matrix(ndim: int, angles):
    """angles: [1] for 2D, [3] for 3D (about each axis pair);
    rot = Rx @ Ry @ Rz. Cosine and sine are taken in f64 and rounded to
    f32, so the card's and the CPU's libraries, which may differ in the
    last f32 bit, give the same matrix."""
    dev = angles.device
    c = torch.cos(angles.double()).float()
    s = torch.sin(angles.double()).float()
    if ndim == 2:
        rot = torch.stack([torch.stack([c[0], -s[0]]),
                           torch.stack([s[0], c[0]])])
    else:
        one = torch.ones((), device=dev)
        zero = torch.zeros((), device=dev)

        def mat(rows):
            return torch.stack([torch.stack(r) for r in rows])

        rx = mat([[one, zero, zero], [zero, c[0], -s[0]],
                  [zero, s[0], c[0]]])
        ry = mat([[c[1], zero, s[1]], [zero, one, zero],
                  [-s[1], zero, c[1]]])
        rz = mat([[c[2], -s[2], zero], [s[2], c[2], zero],
                  [zero, zero, one]])
        rot = rx @ ry @ rz
    return _homogeneous(ndim, rot, torch.zeros(ndim, device=dev))


def scale_shear_matrix(ndim: int, scales, shears=None):
    """Diagonal scales; shears fill the off-diagonals row-major (MONAI's
    convention)."""
    lin = torch.diag(scales)
    if shears is not None:
        k = 0
        for i in range(ndim):
            for j in range(ndim):
                if i != j:
                    lin[i, j] = shears[k]
                    k += 1
    return _homogeneous(ndim, lin, torch.zeros(ndim, device=scales.device))


def _per_axis(v, n: int, device):
    """Scalar or per-axis bounds (tensor, list or number) as a [n] tensor."""
    if isinstance(v, torch.Tensor):
        v = v.to(device=device, dtype=torch.float32)
    else:
        v = host_vector(v, device)
    v = v.reshape(-1)
    return (v[:n] if v.numel() > 1 else v).expand(n)


def _uniform(generator, bound, device):
    """Uniform in [-bound, bound], elementwise."""
    u = torch.rand(bound.shape, generator=generator, device=device)
    return (2.0 * u - 1.0) * bound


def random_affine_matrix(
    generator,
    shape: Sequence[int],
    rotate_range=0.0,
    scale_range=0.0,
    shear_range=0.0,
    translate_range=0.0,
    device=None,
):
    """A centred random affine: rotation, scale and shear about the
    volume centre, then a translation (a fraction of the shape)."""
    ndim = len(shape)
    n_angles = 1 if ndim == 2 else 3
    angles = _uniform(generator, _per_axis(rotate_range, n_angles, device),
                      device)
    scales = 1.0 + _uniform(generator, _per_axis(scale_range, ndim, device),
                            device)
    shears = _uniform(
        generator, _per_axis(shear_range, ndim * (ndim - 1), device), device
    )
    trans = _uniform(
        generator, _per_axis(translate_range, ndim, device), device
    ) * host_vector(list(shape), device)
    m = (
        center_matrix(shape, +1.0, device)
        @ rotation_matrix(ndim, angles)
        @ scale_shear_matrix(ndim, scales, shears)
        @ center_matrix(shape, -1.0, device)
    )
    m[:ndim, ndim] += trans
    return m


# -- flips --------------------------------------------------------------------


def _bernoulli(generator, prob: float, n: int, device):
    return torch.rand((n,), generator=generator, device=device) < prob


def apply_flips(vol, gates, axes: Sequence[int]):
    """Flips each axis ``axes[i]`` of ``vol`` where ``gates[i]`` is set."""
    for i, ax in enumerate(axes):
        vol = torch.where(gates[i], torch.flip(vol, dims=(ax,)), vol)
    return vol


def random_flip(generator, vol, axes: Sequence[int], prob: float = 0.5):
    """Flips each spatial axis in ``axes`` with probability ``prob``."""
    return apply_flips(vol, _bernoulli(generator, prob, len(axes),
                                       vol.device), axes)


def random_flip_with_matrix(
    generator, vol, axes: Sequence[int], ndim: int, prob: float = 0.5
):
    """``random_flip`` that also returns the reflection matrix mapping
    output voxel -> input voxel."""
    gates = _bernoulli(generator, prob, len(axes), vol.device)
    return (apply_flips(vol, gates, axes),
            _flip_matrix(gates, vol.shape[:ndim], axes))


def _flip_matrix(gates, shape: Sequence[int], axes: Sequence[int]):
    """Reflection of each axis whose gate is set, about the volume centre
    (i -> (s-1) - i)."""
    ndim = len(shape)
    dev = gates.device
    diag = torch.ones(ndim, device=dev)
    trans = torch.zeros(ndim, device=dev)
    for i, d in enumerate(axes):
        diag[d] = torch.where(gates[i], -1.0, 1.0)
        trans[d] = torch.where(gates[i], float(shape[d] - 1), 0.0)
    return _homogeneous(ndim, torch.diag(diag), trans)


def compose_flips(
    generator, matrix, shape: Sequence[int], axes: Sequence[int],
    prob: float = 0.5,
):
    """Folds per-axis random reflections into a warp matrix, so the warp
    realizes the flips and no separate pass over the volume is needed."""
    gates = _bernoulli(generator, prob, len(axes), matrix.device)
    return matrix @ _flip_matrix(gates, shape, axes)


# -- crops --------------------------------------------------------------------


def dynamic_crop(vol, start, size: Sequence[int]):
    """The ``size`` box of ``vol`` [*S, ...] at ``start`` (ints or an int
    tensor on the volume's device, read without a host sync). As in
    ``jax.lax.dynamic_slice`` a negative start counts from the end and the
    box is clamped into the volume. A gather."""
    ndim = len(size)
    for d in range(ndim):
        if size[d] > vol.shape[d]:
            raise ValueError(
                f"crop {tuple(size)} exceeds the volume "
                f"{tuple(vol.shape[:ndim])}"
            )
    dev = vol.device
    start = torch.as_tensor(start, device=dev).long().reshape(ndim)
    dims = torch.tensor(vol.shape[:ndim], device=dev)
    start = torch.where(start < 0, start + dims, start)
    start = torch.minimum(start.clamp_min(0),
                          dims - torch.tensor(size, device=dev))
    idx = []
    for d in range(ndim):
        shape = [1] * ndim
        shape[d] = size[d]
        idx.append((start[d] + torch.arange(size[d], device=dev))
                   .reshape(shape))
    return vol[tuple(idx)]


def _crop_maxs(shape: Sequence[int], size: Sequence[int], device):
    return torch.tensor(
        [max(int(shape[d]) - int(size[d]), 0) for d in range(len(size))],
        device=device,
    )


def _uniform_start(generator, shape, size, device):
    """A start uniform over ``[0, max]`` on each axis."""
    maxs = _crop_maxs(shape, size, device)
    u = torch.rand((len(size),), generator=generator, device=device)
    return torch.minimum(torch.floor(u * (maxs + 1)).long(), maxs)


def random_crop(generator, vol, size: Sequence[int], start=None):
    """Uniform random crop of fixed ``size``; ``start`` replaces the draw."""
    if start is None:
        start = _uniform_start(generator, vol.shape[:len(size)], size,
                               vol.device)
    return dynamic_crop(vol, start, size)


def fg_centred_start(centre, shape: Sequence[int], size: Sequence[int]):
    """The start that centres a ``size`` crop on ``centre``, clipped into
    the volume."""
    maxs = _crop_maxs(shape, size, centre.device)
    half = torch.tensor([s // 2 for s in size], device=centre.device)
    return torch.minimum((centre.long() - half).clamp_min(0), maxs)


def pos_neg_crop(
    generator,
    vol,
    label,
    size: Sequence[int],
    fg_indices,
    n_fg,
    pos_ratio: float = 0.5,
    start=None,
):
    """RandCropByPosNegLabeld's analogue: with probability ``pos_ratio``
    the crop centres on a foreground voxel drawn from ``fg_indices``
    [max_fg, ndim] (its first ``n_fg`` rows valid), else its start is
    uniform; a label with no foreground always crops uniformly. ``start``
    replaces the draws. Returns (image crop, label crop, start); the label
    keeps its rank."""
    ndim = len(size)
    dev = vol.device
    shape = vol.shape[:ndim]
    if start is None:
        uniform = _uniform_start(generator, shape, size, dev)
        n_fg = torch.as_tensor(n_fg, device=dev)
        u = torch.rand((), generator=generator, device=dev)
        idx = torch.floor(u * n_fg.clamp_min(1)).long()
        idx = torch.minimum(idx, n_fg.clamp_min(1) - 1)
        centre = torch.as_tensor(fg_indices, device=dev)[idx]
        use_fg = (torch.rand((), generator=generator, device=dev)
                  < pos_ratio) & (n_fg > 0)
        start = torch.where(use_fg, fg_centred_start(centre, shape, size),
                            uniform)
    return dynamic_crop(vol, start, size), dynamic_crop(label, start,
                                                        size), start

"""Deconfounder mode dispatch: ``train``, ``test`` and ``predict``."""

import importlib

_PKG = "adell_mri_torch.entrypoints.classification_deconfounder"
supported_modes = {mode: f"{_PKG}.{mode}"
                   for mode in ("predict", "test", "train")}


def main(arguments):
    if len(arguments) == 0 or arguments[0] in ("help", "--help", "-h"):
        print(f"\n\tSupported modes: {sorted(supported_modes)}")
        return
    mode = arguments[0]
    if mode not in supported_modes:
        raise NotImplementedError(
            f"\n\tMode {mode} not supported (yet)\n\t"
            f"Supported modes: {sorted(supported_modes)}"
        )
    importlib.import_module(supported_modes[mode]).main(arguments[1:])

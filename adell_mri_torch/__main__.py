"""
CLI dispatch: ``python -m adell_mri_torch <mode> <submode> ...``.

Counterpart of ``adell_mri_tpu/__main__.py`` for the modes ported so far.
"""

import importlib
import logging
import os
import sys

supported_modes = ["segmentation", "classification", "classification_ensemble",
                   "classification_mil", "classification_deconfounder",
                   "ssl"]


def main(arguments=None):
    arguments = sys.argv[1:] if arguments is None else arguments
    if len(arguments) == 0 or arguments[0] == "help":
        print(f"\n\tSupported modes: {supported_modes}")
        return
    if not logging.getLogger().handlers:
        # progress (epochs, resume, early stopping) to standard error
        logging.basicConfig(
            level=os.environ.get("ADELL_LOG_LEVEL", "INFO"),
            format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        )
    mode = arguments[0]
    if mode not in supported_modes:
        raise NotImplementedError(
            f"\n\tMode {mode} not supported (yet)\n\t"
            f"Supported modes: {supported_modes}"
        )
    module = importlib.import_module(
        f"adell_mri_torch.entrypoints.{mode}.__main__"
    )
    module.main(arguments[1:])


if __name__ == "__main__":
    main()

"""`module_availability_torch` -- dependency probe of the PyTorch port.
Parity: misopy/module_availability.py:11-56, as
miso_tpu/cli/module_availability.py adapted it, for the CUDA stack: the
Python modules, the CUDA device as torch sees it, ``nvcc`` (the kernels
build from source at first use) and the port's native host library.
Returns the number of things missing."""
from __future__ import annotations

import sys

MODULES = ["numpy", "scipy", "torch", "matplotlib"]


def main(argv=None) -> int:
    unavailable = 0
    print("Checking availability of Python modules for MISO-TPU (torch)")
    for mod in MODULES:
        try:
            __import__(mod)
            print("  - %s: available" % mod)
        except ImportError:
            print("  - %s: NOT available" % mod)
            unavailable += 1
    try:
        import torch
        if torch.cuda.is_available():
            print("CUDA device: %s, %d device(s)"
                  % (torch.cuda.get_device_name(0),
                     torch.cuda.device_count()))
        else:
            print("CUDA device: NOT available (--device cpu runs the "
                  "plain versions)")
            unavailable += 1
    except Exception as e:
        print("torch device init failed: %s" % e)
        unavailable += 1
    try:
        from miso_tpu_torch.kernels import _nvcc
        print("nvcc: %s" % _nvcc())
    except RuntimeError as e:
        print("nvcc: NOT available (%s)" % e)
        unavailable += 1
    from miso_tpu_torch import native
    lib = native.load()
    if lib is None:
        print("native host library: NOT available (no C++ toolchain, or "
              "MISO_NO_NATIVE set; the Python fallbacks run)")
        unavailable += 1
    else:
        print("native host library: %s" % lib._name)
    if unavailable == 0:
        print("All modules available!")
    return unavailable


if __name__ == "__main__":
    sys.exit(main())

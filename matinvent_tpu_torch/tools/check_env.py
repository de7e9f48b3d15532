"""Preflight of the card machine (``scripts/check_env.py`` of the JAX
package): what the port needs to run there.

    python -m matinvent_tpu_torch.tools.check_env

Required: torch built for CUDA with a device of compute capability 9.0
(the kernels are built for ``sm_90a``), numpy, scipy, ``nvcc`` where
``csrc/build.py`` finds it (PATH or ``/usr/local/cuda/bin``) and ``g++``
(``csrc/charge_balance.cpp``, ``csrc/structure_fit.cpp``). Reported but
optional: the CUTLASS headers (``/usr/local/cutlass/include``; the port's
kernels include none of them) and ``ssh`` (the DFT reward's bridge). A
CPU-only torch is never reported fit. Exits 1 when anything required is
missing.
"""
from __future__ import annotations

import importlib
import shutil
import sys
from pathlib import Path

REQUIRED = ["torch", "numpy", "scipy"]
CUTLASS = Path("/usr/local/cutlass/include/cutlass/cutlass.h")
CAPABILITY = (9, 0)
TOOLS = {"g++": "csrc/charge_balance.cpp and csrc/structure_fit.cpp are built with it"}
OPTIONAL_TOOLS = {"ssh": "remote DFT reward bridge"}


def main() -> int:
    ok = True
    for mod in REQUIRED:
        try:
            m = importlib.import_module(mod)
            print(f"[ok]   {mod} {getattr(m, '__version__', '')}")
        except ImportError:
            print(f"[FAIL] {mod} missing (required)")
            ok = False
    try:
        import torch
    except ImportError:
        torch = None
    if torch is not None:
        if torch.version.cuda is None or not torch.cuda.is_available():
            print(f"[FAIL] CUDA not available (torch {torch.__version__}, built for CUDA "
                  f"{torch.version.cuda}): the port runs on an NVIDIA card")
            ok = False
        else:
            cap = torch.cuda.get_device_capability(0)
            name = torch.cuda.get_device_name(0)
            if cap != CAPABILITY:
                print(f"[FAIL] {name}: compute capability {cap}, the kernels need {CAPABILITY}")
                ok = False
            else:
                print(f"[ok]   CUDA {torch.version.cuda}, {torch.cuda.device_count()} x {name}")
    from matinvent_tpu_torch.csrc.build import find_nvcc

    try:
        print(f"[ok]   nvcc {find_nvcc()}")
    except RuntimeError as err:
        print(f"[FAIL] {err}")
        ok = False
    for tool, why in TOOLS.items():
        if shutil.which(tool):
            print(f"[ok]   {tool}")
        else:
            print(f"[FAIL] {tool} missing (required: {why})")
            ok = False
    print(f"[ok]   CUTLASS headers {CUTLASS.parent.parent}" if CUTLASS.exists()
          else f"[--]   CUTLASS headers missing (optional: {CUTLASS.parent.parent}; "
               "no kernel includes them)")
    for tool, why in OPTIONAL_TOOLS.items():
        print(f"[ok]   {tool}" if shutil.which(tool) else f"[--]   {tool} missing (optional: {why})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

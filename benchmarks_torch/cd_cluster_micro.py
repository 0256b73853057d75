"""Build and run the CD cluster route's microbenchmarks on one NVIDIA GPU.

    python3 benchmarks_torch/cd_cluster_micro.py

``cd_sync_micro.cu`` times the waits a cluster step is made of (a block
barrier, a cluster barrier, a shared-memory pass, a DSMEM round trip and a
DSMEM store); ``cd_product_micro.cu`` times one of the step's products on
one SM, on the tensor cores in 3xTF32 and in one pass, and on the CUDA
cores. Each is compiled with nvcc into ku_torch/_build (git-ignored) and
run; their lines are printed, then the card's name and power limit as
nvidia-smi gives them.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ku_torch.kernels import _build  # noqa: E402


def main() -> int:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in ("cd_sync_micro", "cd_product_micro"):
        exe = _build.BUILD_DIR / name
        subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-o", str(exe),
                        str(Path(__file__).resolve().parent / f"{name}.cu")], check=True)
        print(f"# {name}", flush=True)
        subprocess.run([str(exe)], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

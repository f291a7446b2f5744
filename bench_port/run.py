#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on one CUDA card and print its
result as one JSON line (the last line of standard output):

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. Caches of the program's builds stay in
the checkout's build/ directory; captures and WAVs go to a temporary
directory under TMPDIR and are deleted at exit. Exits 2 without a result
where no CUDA card is present, 3 where the process loaded JAX or the JAX
package.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "bench_port"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# The checkout's root, not this directory, heads the import path.
sys.path[0] = str(ROOT)

from bench_port import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], harness.process_start()))

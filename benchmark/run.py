"""python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>: one run of one cell of BENCHMARK.json on the card(s) of
the machine it starts on; its result is the last line of stdout."""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths; the
# port builds its kernels into mo_renderer_tpu_torch/_build/
CACHE = os.path.join(ROOT, "benchmark", ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["NCCL_SHM_DISABLE"] = "1"  # nothing in /dev/shm
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    import logging

    # the port logs every prepare and topology change at INFO; a run
    # keeps stderr for the check's lines
    logging.basicConfig(level=logging.WARNING)
    from benchmark.harness import main

    main.T0 = T0
    sys.exit(main.main(sys.argv[1:]))

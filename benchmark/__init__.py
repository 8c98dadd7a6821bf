"""The benchmark of mo_renderer_tpu_torch, the PyTorch and CUDA port:
``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  ``BENCHMARK.json`` at the checkout's root names the
cells; each configuration, traffic mix and per-layer metric is a file of
its own here, found by its name (``harness.spec``)."""

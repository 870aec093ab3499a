"""portbench: the benchmark of `gunrockinst_tpu_torch` on one CUDA card.

One command, `python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`, run from the root of a checkout.  Every
cell, configuration, traffic mix and metric is named in
`BENCHMARK.json` and found by that name under this folder:

  * `configs/<config>.json`: a deployment (a graph and its scale), made
    by `graphs/<generator>.py` from the seed;
  * `traffic/<traffic>.json`: the query mix (primitive, call, warm-up,
    checked sample), sent through `queries/<primitive>.py` by one caller
    in a closed loop, a fresh root a query (`harness.draw_roots`);
  * `metrics/<metric>.py`: one reader per metric, from the run's record;
  * `reference/<primitive>.py`: the plain PyTorch answer and the
    comparison that decides `correct`; `work/<primitive>.py`: the bytes
    a query needs, for its roofline share.

Nothing here imports `jax` or the JAX package `gunrockinst_tpu`; only
the adaptors under `queries/` import the port.
"""

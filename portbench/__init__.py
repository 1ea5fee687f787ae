"""The benchmark of the PyTorch/CUDA port (``hawkeye_tpu_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once on the cards of this machine and prints
one JSON result line last. The cells, configurations, traffic mixes and
per-layer metrics are files of their own under this folder (``catalog``),
named in ``BENCHMARK.json`` beside it. Nothing here imports JAX or the JAX
package; ``reference/`` imports nothing of the port either.
"""

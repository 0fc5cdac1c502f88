"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One run serves one cell of ``BENCHMARK.json`` (a model configuration under
a traffic mix) through the port's stream frontend on one card, measures a
window of ``--seconds``, checks what the timed path served against a plain
float32 reference, and prints one JSON line:

    python3 portbench/run.py --workload nemo-code --seed 7 --seconds 50 \
        --trace 0

Everything that belongs to one configuration, traffic mix, metric or
correctness check is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and ``checks/<workload>.json``. Nothing here
imports JAX or the JAX package ``repro``; the reference
(``reference/``) and the work counters (``work/``) import nothing of the
port either.
"""

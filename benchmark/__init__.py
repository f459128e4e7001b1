"""The benchmark of lis_tpu_torch: time to solution on the H100.

One command runs one cell once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration (``configs/``), its traffic mix (``traffic/``), the limits of
its comparison (``limits/``) and each metric's reader (``metrics/``).  The
plain reference that decides ``correct`` is in ``reference/``.  Nothing
here imports jax or lis_tpu; of the program it imports only
``lis_tpu_torch``, the system under test.
"""

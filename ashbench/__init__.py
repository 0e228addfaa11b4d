"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of ASH.

``python3 ashbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (see ``harness``); ``sweep.py``
finds an online cell's highest sustained rate and ``control.py`` reads
the control of the comparison that decides ``correct``.  The files
that define cells, configurations, traffic mixes, metrics and work
counts are found by name (``spec``).
"""

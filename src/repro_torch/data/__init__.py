"""Data on the port: the workload generators (``workloads``: Zipfian,
hot-set and string-key schedules over the YCSB mixes, and the ``replay``
oracle) and the trainer's token pipeline with its persistent cursor
(``pipeline``)."""

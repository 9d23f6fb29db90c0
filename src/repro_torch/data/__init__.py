"""Workload generators of the port: the adversarial matrix
(``workloads``: Zipfian, hot-set and string-key schedules over the YCSB
mixes, and the ``replay`` oracle)."""

"""Benchmarks of the port: ``kernels`` times each hand-written kernel against
its plain version; ``timing`` holds the device timer they and
``chip_smoke.py`` share."""

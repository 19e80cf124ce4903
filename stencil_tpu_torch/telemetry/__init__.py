"""Telemetry: the step-metric columns that ride the health probe
(``probe.py``).

PyTorch-port counterpart of ``stencil_tpu/telemetry``; the tracer, the
event log, the metrics registry and its server wait for ROADMAP A12.
"""

"""Resilience: the health probe and sentinel (``health.py``).

PyTorch-port counterpart of ``stencil_tpu/resilience``; the recovery
driver, the fault plan and the checkpoints wait for ROADMAP A11.
"""

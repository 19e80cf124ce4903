"""Checks of the port's programs (counterparts of ``stencil_tpu/analysis``)."""

"""Layer library of the port (counterpart of ``recommendations_tpu/nn``)."""

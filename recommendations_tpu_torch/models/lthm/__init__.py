"""LTHM sequence encoder (counterpart of ``recommendations_tpu/models/lthm``)."""

"""Factorized-DLRM ranker (counterpart of ``recommendations_tpu/models/ranker``)."""

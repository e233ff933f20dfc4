"""DeepSDF models (counterpart of ``softbody_tpu/models``)."""

"""The JAX package's examples on the port: ``python -m
softbody_tpu_torch.examples.inflate_demo`` and ``python -m
softbody_tpu_torch.examples.million_particles``."""

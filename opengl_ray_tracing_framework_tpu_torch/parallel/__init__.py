"""Differentiable rendering (PyTorch port of
opengl_ray_tracing_framework_tpu.parallel). Single device; the sharded
gradients of the JAX package come with the multi-device port."""

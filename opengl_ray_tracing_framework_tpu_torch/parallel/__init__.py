"""Differentiable and multi-device rendering (PyTorch port of
opengl_ray_tracing_framework_tpu.parallel): autodiff.py holds the
gradients, single-process and sharded over ranks; sharding.py the
row-sharded render on torch.distributed."""

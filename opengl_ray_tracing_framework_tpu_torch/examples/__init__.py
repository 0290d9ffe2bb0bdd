"""Runnable examples of the port (`python -m
opengl_ray_tracing_framework_tpu_torch.examples.<name>`)."""

"""Independent golden oracle: a scalar transcription of the reference GLSL.

This package is the *test reference* demanded by SURVEY §4.1: a
line-for-line transcription of /root/reference/executable/shader.frag
into scalar NumPy, with NO imports from the production package
(fourd_ray_tracing_tpu). Its only purpose is to break the
self-referential allclose loop — a math bug shared by the jnp renderer
and the Pallas forward kernel is invisible to tests that compare them to
each other, but not to tests that compare them to this module.

Do not import anything from fourd_ray_tracing_tpu here, ever.
"""
from oracle.frag import OracleCamera, render_image, render_light, trace
from oracle.scenes import SCENES

"""fourd_ray_tracing_tpu — a differentiable 4D path tracer in JAX.

A brand-new JAX/Pallas framework with the capabilities of the reference
4D ray tracer (an SFML/GLSL interactive app): 4D camera orientation,
hypersphere / hyperplane / 4D-cylinder / duocylinder / tiger / hypercube
primitives, an emissive-diffuse-mirror BSDF, the Newton-inverted
S^3-volume direction sampler, progressive accumulation — re-designed
for accelerators:

* all rendering math lives in pure, batched jnp functions (`ops/`),
  shared between a CPU-runnable oracle renderer (`models/renderer.py`)
  and a fused Pallas-Triton forward kernel for NVIDIA GPUs
  (`ops/pallas/`);
* scenes are differentiable parameter pytrees (`models/scene.py`), not
  compile-time shader text;
* rays shard over a `jax.sharding.Mesh` with scene params replicated and
  gradients `psum`-reduced across devices (`parallel/`);
* the host runtime (config parsing, camera/input state machine) has a
  native C++ implementation (`native/`) mirroring the reference's C++
  host layer, with a pure-Python fallback.

Reference behavior citations use `file:line` into the upstream repo
(BusyginIvan/4D_ray_tracing), e.g. `shader.frag:471` for the trace loop.
"""

__version__ = "0.1.0"

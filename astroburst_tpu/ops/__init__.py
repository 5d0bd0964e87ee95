"""Shared compute primitives (jit-compiled JAX).

Design notes: quantiles use compare-count range refinement instead of
scatter histograms, FFTs are matmul four-step (complex as (re, im) f32
pairs), and resampling prefers separable static-tap stencils over
gathers. These forms were chosen for the accelerator the library was
first built on; whether each still beats the native op (jnp.fft,
sort, scatter) on the GPU is open (ROADMAP D3). See DESIGN.md.
"""

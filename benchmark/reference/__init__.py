"""The plain reference the benchmark judges the port against.

Plain numpy and torch only: nothing here imports ``raytrace_tpu_torch``,
``raytrace_tpu`` or JAX, and nothing takes a table the program built.  The
scene generators and the viewport are frozen copies of the reference
renderer's (src/scene.h, shaders/shader.rgen); ``tracer`` renders chosen
pixels by brute force over every sphere with the sample stream of the
reference GLSL (TEA seed, LCG draws) and fast mode's Russian roulette.
"""

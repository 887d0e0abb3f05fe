"""Hand-written Hopper kernels of the port and the backend axis.

``modes`` names the scoring backends; ``rows_dot`` is the CUDA rows
kernel with its plain torch version; ``build`` compiles ``csrc/*.cu``
with ``nvcc`` at first use. Importing this package builds nothing."""

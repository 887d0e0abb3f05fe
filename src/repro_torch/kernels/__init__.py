"""Hand-written Hopper kernels of the port and the backend axis.

``modes`` names the scoring backends; ``rows_dot`` is the CUDA rows
kernel and ``block_scan`` the CUDA block-scan kernel, each with its
plain torch version; ``ops`` holds the full-scan entry points;
``build`` compiles ``csrc/*.cu`` with ``nvcc`` at first use. Importing
this package builds nothing."""

"""Hand-written Hopper kernels of the port and the backend axis.

``modes`` names the scoring backends; ``rows_dot`` is the CUDA rows
kernel, ``block_scan`` the CUDA block-scan kernel and ``topk`` the CUDA
top-k select kernel, each with its plain torch version (``topk`` also
holds the port's stable-sort ``top_k``); ``ops`` holds the full-scan
entry points; ``build`` compiles ``csrc/*.cu`` with ``nvcc`` at first use. Importing
this package builds nothing."""

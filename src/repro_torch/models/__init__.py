"""Models of the port (``repro/models``' counterparts): the SPLADE
encoder, the decoder-only LM family (``transformer``, ``moe``), GAT
(``gnn``), the RecSys models DeepFM, DCN-v2, SASRec and DIN (``recsys``)
and the building blocks they share (``common``)."""

"""Models of the port (``repro/models``' counterparts): the SPLADE
encoder, the decoder-only LM family (``transformer``, ``moe``) and the
building blocks they share (``common``). The GNN and RecSys models are
still to port (ROADMAP A11)."""

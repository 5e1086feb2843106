"""The GNN family: SchNet, EGNN, MACE and EquiformerV2 (``models``), their
substrate (``common``) and the equivariant tables (``equivariant``)."""

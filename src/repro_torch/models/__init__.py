"""Models: the transformer family (``transformer``) and its substrate
(``common``)."""

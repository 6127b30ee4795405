"""Host-driven device operations of the port (``warp``: the depth-guided
cross-view correspondences between the supersampling and refine
stages)."""

"""NeRF primitives: rays, scenes, the dense, hash and VM grids, decoder,
volume rendering, and the models over them."""

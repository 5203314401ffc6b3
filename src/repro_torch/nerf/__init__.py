"""NeRF primitives: rays, scenes, the dense grid, decoder, volume rendering."""

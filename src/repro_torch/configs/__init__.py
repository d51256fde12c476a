"""NeuraLUT chain geometries (copies of ``repro.configs.neuralut_*``)."""

"""NeuraLUT chain geometries and PolyLUT-Add LUT graphs (copies of
``repro.configs.neuralut_*`` and ``repro.configs.polylut_add_*``)."""

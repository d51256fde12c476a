"""NeuraLUT chain geometries, PolyLUT-Add LUT graphs and the dense LMs
(copies of ``repro.configs.neuralut_*``, ``repro.configs.polylut_add_*``,
``lm_100m``, ``llama3_8b``, ``yi_9b``, ``granite_34b`` and
``gemma3_12b``)."""

"""NeuraLUT chain geometries, PolyLUT-Add LUT graphs and the LMs
(copies of ``repro.configs.neuralut_*``, ``repro.configs.polylut_add_*``,
``lm_100m``, ``llama3_8b``, ``yi_9b``, ``granite_34b``, ``gemma3_12b``,
``qwen2_moe_a2p7b``, ``deepseek_v2_lite_16b``, ``jamba_v0_1_52b``,
``xlstm_350m``, ``whisper_small`` and ``qwen2_vl_72b``)."""

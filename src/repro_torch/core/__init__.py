"""Model core: config, quantizers, sub-networks, conversion, LUT inference."""

"""Model stack of the port: config, parameter templates, layers, model."""

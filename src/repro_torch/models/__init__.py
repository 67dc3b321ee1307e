"""The LM backbone: configuration, layers, the decoder stack and the serving
half of the LM head (slice 4)."""

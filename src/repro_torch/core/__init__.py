"""Tree generator, negative samplers and softmax heads of the paper."""

"""Model assembly: params, layers, model entry points and the weight bridge."""

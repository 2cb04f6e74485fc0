"""Networks, layers, configurations."""

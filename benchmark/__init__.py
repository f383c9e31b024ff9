"""The port's benchmark: the harness, its data and the plain reference."""

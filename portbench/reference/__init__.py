"""The plain reference of the benchmark."""

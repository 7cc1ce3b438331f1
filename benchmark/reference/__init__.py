"""The plain reference the benchmark checks renders against."""

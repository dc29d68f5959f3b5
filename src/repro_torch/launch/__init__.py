"""Entry points of the port: step functions and the serving CLI."""

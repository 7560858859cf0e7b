"""Entry points that run the port's model outside the serving engine."""

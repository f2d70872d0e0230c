"""Entry points of the port: LM serving."""

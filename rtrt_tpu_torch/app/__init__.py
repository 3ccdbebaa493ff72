"""Applications of the port: the headless renderer (app/headless.py)."""

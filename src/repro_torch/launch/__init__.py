"""Entry points: the serving driver (training follows with its slice)."""

"""Entry points: the training launcher and its optimizer pick."""

"""Training: the cyclical train step, its optimizer and state."""

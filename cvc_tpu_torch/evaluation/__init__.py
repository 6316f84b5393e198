"""Evaluation of the port: the PTB tokenizer and CIDEr-D."""

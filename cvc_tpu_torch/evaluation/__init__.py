"""Evaluation of the port: the pure-Python scorers (PTB tokenizer, BLEU,
CIDEr-D, METEOR, SPICE-lite, the jar wrappers), grounding F1, the split
evaluator and the cycle probes."""

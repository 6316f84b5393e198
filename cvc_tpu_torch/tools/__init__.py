"""Command-line tools of the port (run as `python -m cvc_tpu_torch.tools.<name>`)."""

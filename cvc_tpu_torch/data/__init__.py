"""Request packing and the vocabulary of the port."""

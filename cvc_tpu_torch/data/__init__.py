"""The data layer of the port: vocabulary, datasets, the synthetic world
and the batch pipeline."""

"""The data layer of the port: vocabulary, datasets, the synthetic world,
the batch pipeline and the device-resident dataset."""

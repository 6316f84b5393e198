"""cvc_tpu_torch: the PyTorch/CUDA port of `cvc_tpu`, for one NVIDIA H100.

It mirrors the JAX package's layout and names, keeps the JAX parameter
layout (weights cross as the flat `a/b/c` npz), and replaces each Pallas
kernel on its path with a CUDA kernel written for Hopper (`csrc/`), built
with nvcc at first use. It imports nothing from `cvc_tpu`.

Ported so far: serving (`serving.Captioner` with beam search and greedy
decoding), the cyclical train step (`training.step.make_train_step`:
decode -> localize -> reconstruct -> masked XE -> clip + Adam, with
scheduled sampling), the data layer (`data/`: the synthetic world, the HDF5
+ JSON readers, the batch pipeline; `config.config_from_args`), temperature
sampling and SCST (`training.scst`), the region transformer
(`models.transformer`, `ModelConfig.obj_interact`), evaluation
(`evaluation/`: the scorers, grounding, `evaluator`, `probes`),
checkpoints (`training.checkpoint`), the device-resident dataset
(`data.device_data`), the epoch loop (`training.loop.train`), the CLIs
(`python -m cvc_tpu_torch.train`, `python -m cvc_tpu_torch.eval`),
`serving.Captioner.from_checkpoint`, the reference `.pth` importer
(`models.torch_import`, `tools.import_torch_checkpoint`), the C++ batch
packer and CIDEr-D (`native`), data and vocabulary-head parallelism over
`torch.distributed` ranks (`parallel`) and the utilities (`utils`).
Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

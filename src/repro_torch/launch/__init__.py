"""Entry points of the port (`repro.launch`): the batched grid sweep, the
training driver (`repro_torch.launch.train`) and the subprocess sweep
(`sweep --mode net`)."""

"""Task assembly of the port (`repro_torch.sim.tasks`)."""

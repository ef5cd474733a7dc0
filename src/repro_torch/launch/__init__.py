"""Entry points of the port (`repro.launch`): the batched grid sweep."""

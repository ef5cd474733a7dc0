"""Models of the port: the paper's linear model (`small`) and the model
zoo's dense family (`config`, `layers`, `dense`, `api`)."""

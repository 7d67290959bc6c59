"""Joint train step, render pipelines, optimizers and their factory."""

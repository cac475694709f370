"""Editing pipelines: (toolbox, record, image, rng) -> EditOutcome."""

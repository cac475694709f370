"""The factory's quality gates: pre-filter, post-filter and the scorers."""

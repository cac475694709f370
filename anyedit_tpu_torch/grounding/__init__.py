"""The grounding stage: phrase -> detector boxes -> SAM masks."""

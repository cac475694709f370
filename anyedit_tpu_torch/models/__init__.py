"""Models of the IP2P editor slot: SD UNet, AutoencoderKL, CLIP text tower."""

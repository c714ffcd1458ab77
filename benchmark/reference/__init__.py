"""Plain float32 PyTorch references of what the benchmark's cells run,
written from upstream Jukebox's definitions (jukebox/prior/*,
jukebox/transformer/*, jukebox/vqvae/*). They import torch and numpy
alone: nothing of the program under test."""

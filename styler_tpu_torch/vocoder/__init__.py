"""Vocoders of the port: the iSTFTNet generator (HiFi-GAN is a later slice)."""

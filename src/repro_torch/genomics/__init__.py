"""Genomics substrate: synthetic read sets and the read mapper."""

from repro_torch.genomics.synth import PROFILES, ReadSet, SynthProfile, make_reference, sample_read_set

"""Genomics substrate: synthetic read sets, FASTQ I/O and the read mapper."""

from repro_torch.genomics.fastq import read_fastq, write_fastq
from repro_torch.genomics.synth import PROFILES, ReadSet, SynthProfile, make_reference, sample_read_set

"""Mapping orchestration: external mapper subprocess pipelines
(bam_generator.rs:374-1040, mapping_index_maintenance.rs), and
`makedb` (persistent indexes, with the CheckM filter and
dereplication).
"""

from __future__ import annotations


def build_mapping_sources(args, filter_params, flag_filters):
    from .pipeline import build_mapping_sources as impl
    return impl(args, filter_params, flag_filters)


def make_bams(args):
    from .pipeline import make_bams as impl
    return impl(args)


def makedb(args):
    from .pipeline import makedb as impl
    return impl(args)

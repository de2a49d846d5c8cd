"""Mapping orchestration: external mapper subprocess pipelines
(bam_generator.rs:374-1040, mapping_index_maintenance.rs).

`makedb` (persistent indexes, with the CheckM filter and
dereplication) is not part of this package yet.
"""

from __future__ import annotations


def build_mapping_sources(args, filter_params, flag_filters):
    from .pipeline import build_mapping_sources as impl
    return impl(args, filter_params, flag_filters)


def make_bams(args):
    from .pipeline import make_bams as impl
    return impl(args)


from .bam import BamReader, BamHeader, RecordBatch  # noqa: F401

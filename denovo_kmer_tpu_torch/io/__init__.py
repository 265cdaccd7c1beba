"""Host-side I/O feeder layer: the pure-Python BGZF/BAM/FASTA codecs and the port's C++
ingest shim (``io/_native``), which inflates BGZF blocks and 2-bit-packs reads into
buffers the card takes. Both expose the same record interface."""

from denovo_kmer_tpu_torch.io.bam import BamReader, BamRecord, BamWriter, read_bam_records
from denovo_kmer_tpu_torch.io.bgzf import BgzfReader, BgzfWriter
from denovo_kmer_tpu_torch.io.fasta import read_fasta, read_fastq

__all__ = [
    "BamReader",
    "BamWriter",
    "BamRecord",
    "read_bam_records",
    "BgzfReader",
    "BgzfWriter",
    "read_fasta",
    "read_fastq",
    # imported lazily by consumers (keep module import light):
    #   io.cram (CramReader [.iter_seq_chunks = packed-feeder handoff],
    #            write_cram, read_cram_records), io.rans,
    #   io.remote (HttpStream, open_binary), io.prefetch, io.native, io.synth,
    #   io.sam (SamReader, read_sam_records, write_sam),
    #   io.vcf (VcfReader, read_vcf_records, write_vcf),
    #   io.bcf (BcfReader, read_bcf_records, write_bcf),
    #   io.tabix (write_tbi, read_vcf_region),
    #   io.fasta faidx surface (build_fai, FaidxFasta, load_reference_indexed),
    #   io.bai (read_bai/read_csi/write_bai/write_csi, read_bam_records_region)
]

from hairsplitter_jax.io.fasta import ReadStore, filter_fastq_by_quality


def test_filter_fastq_by_quality(tmp_path):
    p = str(tmp_path / "in.fastq")
    with open(p, "w") as f:
        f.write("@good\nACGT\n+\nIIII\n")  # Q40
        f.write("@bad\nACGT\n+\n!!!!\n")  # Q0
        f.write("@mid\nACGT\n+\n5555\n")  # Q20
    out = str(tmp_path / "out.fastq")
    kept = filter_fastq_by_quality(p, out, 15)
    assert kept == 2
    store = ReadStore(out)
    assert store.names == ["good", "mid"]

"""`makedb` of the port (mapping/index.generate_persistent_index,
mapping/pipeline.makedb, commands.run_makedb) against the JAX package,
on the CPU.

No mapper ships with this repository: tests/fake_mapper.py is installed
on PATH under the mappers' names (test_torch_mapping's `data` fixture,
seed 9), and its index builds write stub indexes. Both packages run
side by side in their own directories; exit status, standard output, the
message on standard error and every file of the database directory must
be byte-equal: from a reference FASTA for each index format, and from
genome FASTAs (concatenated, after the CheckM filter, after
dereplication).
"""

import pytest

from test_torch_cli_parity import outcome, run_both
from test_torch_mapping import data  # noqa: F401


@pytest.fixture(scope="module")
def checkm(data, tmp_path_factory):  # noqa: F811
    path = tmp_path_factory.mktemp("makedb") / "checkm.tsv"
    path.write_text("Bin Id\tCompleteness\tContamination\n"
                    "gA\t90.0\t1.0\ngB\t40.0\t0.5\n")
    return str(path)


CASES = {
    "reference_minimap2_sr": ["-r", "{ref}"],
    "reference_minimap2_ont": ["-r", "{ref}", "-p", "minimap2-ont"],
    "reference_strobealign": ["-r", "{ref}", "-p", "strobealign"],
    "two_references": ["-r", "{ref}", "{ref2}", "-p", "minimap2-sr"],
    "genome_fasta_files": ["-f", "{gA}", "{gB}"],
    "genome_directory_dereplicated": [
        "-d", "{gdir}", "-x", "fna", "--dereplicate",
        "--dereplication-cluster-method", "sketch"],
    "genome_checkm_filter": ["-f", "{gA}", "{gB}", "--checkm-tab-table",
                             "{checkm}", "--min-completeness", "50"],
    "no_reference": [],
}


@pytest.mark.parametrize("case", list(CASES))
def test_makedb_equals_jax(data, checkm, tmp_path, case):  # noqa: F811
    argv = ["makedb", "-o", "db"] + [a.format(checkm=checkm, **data)
                                     for a in CASES[case]]
    cwds = [tmp_path / "jax", tmp_path / "torch"]
    for c in cwds:
        c.mkdir()
    results = run_both([argv, argv], cwds=cwds, path_dir=data["bindir"])
    want, got = (outcome(r, c) for r, c in zip(results, cwds))
    assert got == want
    rc, stdout, message, files = want
    if case == "no_reference":
        assert rc != 0 and message, want
        return
    assert rc == 0, want
    assert stdout.startswith(b"Generated ")
    assert any(v for v in files.values())

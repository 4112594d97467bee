"""A port-only run of the compare experiment (Auncel against the ELP and LAET
baselines) on synth10K, with the invariants of the harness's other
experiments."""

from torch_parity import DEVICE


def test_compare_end_to_end(tmp_path):
    from auncel_tpu_torch.eval_harness import compare
    rows = compare.run(db="synth10K", ts=100, ses=50, input_k=10,
                       nlist=64, max_topk=50, log_dir=str(tmp_path),
                       reps=1, device=DEVICE)
    names = [r["system"] for r in rows]
    assert names[0] == "auncel" and names[1] == "elp"
    assert names[-2:] == ["laet", "laet_worst"]
    by = {r["system"]: r for r in rows}
    assert by["auncel"]["min_recall"] >= 0.9
    assert 1 <= by["elp"]["mean_probes"] <= 64
    assert all(r["qps"] > 0 and 0 <= r["min_recall"] <= r["mean_recall"]
               <= 1 for r in rows)
    lines = (tmp_path / "Compare_synth10K.log").read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == names
    assert all(len(ln.split()) == 5 for ln in lines)

"""utils/metrics.py of both packages: the same records give the same
summary() and the same dump_jsonl() lines; the port's span times a block
(the JAX package's Timer did)."""
import time

from orbslam2_tpu.utils import metrics as JM
from orbslam2_tpu_torch.utils import metrics as TM

RECORDS = [
    dict(frame_id=i, timestamp=i / 30.0, state=s, inliers=n, keyframes=1 + i // 3,
         points=100 + 7 * i, loops=int(i > 4), track_ms=ms, created_keyframe=i % 3 == 0)
    for i, (s, n, ms) in enumerate([("NOT_INITIALIZED", 0, 51.5), ("OK", 320, 12.25),
                                    ("OK", 311, 9.0), ("LOST", 12, 30.125),
                                    ("OK", 290, 10.5), ("OK", 305, 11.0)])]


def test_summary_and_jsonl_match_jax(tmp_path):
    logs = [JM.MetricsLog(), TM.MetricsLog()]
    assert logs[0].summary() == logs[1].summary() == {}
    for log in logs:
        for r in RECORDS:
            log.append(**r)
    assert logs[0].summary() == logs[1].summary()
    assert logs[1].summary()["tracked"] == 4
    paths = [tmp_path / "jax.jsonl", tmp_path / "port.jsonl"]
    for log, path in zip(logs, paths):
        log.dump_jsonl(path)
    lines = [p.read_text().splitlines() for p in paths]
    assert lines[0] == lines[1] and len(lines[1]) == len(RECORDS)


def test_timer():
    with TM.span("sleep") as t:
        time.sleep(0.02)
    assert 15.0 <= t.elapsed_ms < 2000.0

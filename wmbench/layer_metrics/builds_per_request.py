"""Builds per request: the program's own build counters (utils/prof.py
`counters`, every name `build.*`: key tables, their upload, the Viterbi
decoder, K1's library, the fleet's detectors), which the traced run
resets as it starts and which count while its trace records, over the
traced window's completed requests.  None where the program has no
counters."""


def read(run):
    from audiowmark_tpu_torch.utils import prof
    counters = getattr(prof, "counters", None)
    done = run.done()
    if counters is None or not done:
        return None
    return sum(v for k, v in counters.items()
               if k.startswith("build.")) / len(done)

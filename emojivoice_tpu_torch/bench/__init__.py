"""The port's measurement tools, one module per tool of the JAX repo's
measurement side (``bench.py`` and ``tools/bench_*.py``, ``tools/mfu.py``,
``tools/multilingual_proof.py``):

=====================  ===============================  ======================================
module                 twin                             what it prints (one JSON line)
=====================  ===============================  ======================================
``util``               ``tools/bench_util.py``          (helpers: timing, profiling, the card)
``synthesis``          ``bench.py``                     headline RTF, the bucket × batch sweep
``breakdown``          ``tools/bench_breakdown.py``     compute / e2e / overhead of one call
``serving``            ``tools/bench_serving.py``       closed-loop capacity, open-loop latency
``ttfa``               ``tools/bench_ttfa.py``          time to first audio by strategy
``exported``           ``tools/bench_exported.py``      the exported bundle beside the live path
``vocoder``            ``tools/bench_vocoder.py``       HiFi-GAN K1 against plain, CFM per step
``vocoder_stages``     ``tools/bench_vocoder_stages.py``  each generator piece, with its FLOPs
``mas``                ``tools/bench_mas.py``           K2 against the plain search
``train``              ``tools/bench_train.py``         acoustic and GAN steps per second
``mfu``                ``tools/mfu.py``                 FLOPs counted from shapes over device time
``multilingual``       ``tools/multilingual_proof.py``  long-form synthesis in five languages
=====================  ===============================  ======================================

Each tool has ``main(argv=None) -> int`` and runs on the card (``cuda``);
without one it exits non-zero, and ``--cpu`` runs it on the CPU at whatever
size its flags give, where every time is written as ``"not measured"``.
Each JSON line carries the card's name and count and its power limit.
None of these modules imports JAX, the JAX package, ``bench`` or ``tools``.
"""

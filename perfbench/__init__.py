"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card it is started on and
prints one JSON line.  Everything that belongs to one configuration, one
traffic mix, one cell or one metric sits in a file of its own, found by
the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``   the model configuration as it is run
* ``traffic/<mix>.json``      a traffic mix: its generator (``kind``) and parameters
* ``traffic/<kind>.py``       a generator of requests or batches
* ``workloads/<cell>.json``   a cell: configuration, mix, rate, serving settings, limits
* ``drivers/<driver>.py``     what the window drives (serving, training)
* ``metrics/<metric>.py``     the reader of one metric
* ``rooflines/<entry>.py``    the operations and bytes of one kernel entry
* ``reference/<module>.py``   a model family, named by a configuration's ``reference``:
                              its plain float32 reference (``served_logits``), its
                              parameter tree (``layout``) and its products a token
                              (``per_token_flops``, ``attention_calls``, optionally
                              ``attention_score_flops``)
"""

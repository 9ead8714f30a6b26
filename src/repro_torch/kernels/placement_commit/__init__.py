"""The commit scan (kernel B) and the fused scheduler pass (kernel D).

Proposal family codes of the fused pass: how a lane's preference row is
derived inside the kernel (``csrc/sched_commit.cu``), so the (B, P, N)
preference tensor is never stored. Kept here, in the kernel package, so it
stays importable without the scheduler registry.
"""
FAM_EXTERNAL = 0    # pref comes in via the ``ext`` operand (opaque proposal)
FAM_SCORES = 1      # pref IS the base-pass score matrix (greedy best-fit)
FAM_NODE_ORDER = 2  # pref = -((col - start) % N) — first-fit / round-robin

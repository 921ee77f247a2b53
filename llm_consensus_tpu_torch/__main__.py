"""``python -m llm_consensus_tpu_torch`` — the REPL/CLI entry point."""

from llm_consensus_tpu_torch.cli import main

raise SystemExit(main())

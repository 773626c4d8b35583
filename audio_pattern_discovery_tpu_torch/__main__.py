from audio_pattern_discovery_tpu_torch.cli import main

raise SystemExit(main())

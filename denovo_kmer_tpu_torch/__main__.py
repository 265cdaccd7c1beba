from denovo_kmer_tpu_torch.cli import main

raise SystemExit(main())

from fourd_ray_tracing_tpu.app import main

raise SystemExit(main())
